"""Model code (PyTorch): layers, attention, the decoder-only LM and the
paper's MLP."""
