"""Hand-written CUDA kernels of the torch port, one package per kernel,
each with its plain torch version (`ref`) and its wrapper (`ops`).
`library` builds and loads the shared library and keeps the launch
counts."""
