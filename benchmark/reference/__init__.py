"""The plain reference of the benchmark: unit selection worked out again in
float64 PyTorch from the benchmark's own utterance arrays.  It imports
nothing of the program and takes nothing the program made."""
