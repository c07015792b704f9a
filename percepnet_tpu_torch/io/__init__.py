"""Weight I/O (numpy only)."""
