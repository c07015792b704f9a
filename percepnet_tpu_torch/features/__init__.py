"""Analysis front-end: PCM -> spectra, band energies, pitch, features."""
