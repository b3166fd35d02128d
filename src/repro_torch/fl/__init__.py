"""Federated-learning pieces of the port (serving needs only the
pFedPara split so far)."""
