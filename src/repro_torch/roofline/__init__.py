"""Roofline arithmetic of the port: the H100's peaks, the three roofline
terms and the model-FLOP count of every arch and shape cell
(``analysis``)."""
