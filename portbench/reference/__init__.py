"""Plain PyTorch references of the benchmark's model families, in float32
with TF32 off, computed in blocks where a dense tensor would not fit.
They import nothing of the program: they read the weight tree the
benchmark made (in the program's layout, padding sliced away) and the
published widths of the configuration file."""
