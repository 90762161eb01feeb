"""Data parallelism over torch.distributed: the mesh axes and the data
axis (mesh.py), and the batch draws that keep a data-parallel step equal
to the one-process step (draws.py)."""
