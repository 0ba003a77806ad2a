"""Plain PyTorch references the benchmark judges the program against.
Nothing here imports the program, JAX or the JAX package."""
