"""The plain PyTorch reference that decides `correct`. Imports nothing of the program."""
