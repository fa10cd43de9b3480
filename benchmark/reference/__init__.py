"""Plain PyTorch references.  They import nothing of the program, take
nothing that it made, and see its outputs only to judge them."""
