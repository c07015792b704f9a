"""The PercepNet gain/strength network as an nn.Module."""
