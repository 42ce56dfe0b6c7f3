"""The plain reference that decides ``correct``.

Plain PyTorch in float64 (``conv.py``, ``hog.py``) and the comparison
(``compare.py``). It imports nothing of the program under test and takes
only the inputs the benchmark made: the frames and the spatial bank.
"""
