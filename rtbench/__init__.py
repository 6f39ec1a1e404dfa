"""The port's benchmark harness (``python3 -m rtbench.run``)."""
