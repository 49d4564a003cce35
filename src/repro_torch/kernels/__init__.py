"""Hand-written Hopper kernels of the main path, their plain PyTorch twins,
and the wrappers that pick between them by tensor device."""
