"""Plain PyTorch references, one module per algorithm
(``reference/<algorithm>.py``); nothing here imports the program or JAX."""
