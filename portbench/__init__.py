"""The benchmark of the PyTorch and CUDA port (``graphcast_lite_torch``):
cells, traffic drivers, metric readers, the plain reference and the
comparison that decides ``correct``.  ``run.py`` runs one cell once."""
