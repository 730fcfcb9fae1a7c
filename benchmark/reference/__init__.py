"""The benchmark's plain reference: plain PyTorch and NumPy, independent of
the program under test (it imports nothing of it), run after the window to
decide whether the timed path's output is correct."""
