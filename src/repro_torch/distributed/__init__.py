"""Fault tolerance of the port's launchers (one process; multi-device
training comes with the multi-device slice)."""
