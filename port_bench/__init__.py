"""The benchmark of the PyTorch and CUDA port, ``connectome_gnn_tpu_torch``."""
