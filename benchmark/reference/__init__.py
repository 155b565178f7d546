"""The plain reference of the planner: NumPy and SciPy, float64.

It imports nothing of the program under test. It works each frame's path out
again from the frame the benchmark generated, using the track's construction
(which border cone follows which) for the cone order, and SciPy's FITPACK
(``splprep``/``splev``) for every spline fit.
"""
