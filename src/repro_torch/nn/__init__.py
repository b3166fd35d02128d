"""Model code (PyTorch): layers, attention and the decoder-only LM."""
