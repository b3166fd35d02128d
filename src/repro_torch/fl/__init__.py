"""Federated learning (PyTorch): the sequential FL server and its
client, strategies, identity codec, byte accounting, arrival model and
data seeds. Start at :class:`repro_torch.fl.server.FLServer`."""
