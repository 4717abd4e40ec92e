"""The benchmark's plain reference of the MPC engine.

A frozen copy of the plain PyTorch code of ``upright_tpu_torch`` (problem
assembly, kinematics, balance constraints, the AL-SQP solver with the plain
Riccati recursion, the plant with the plain contact substeps), with every
CUDA kernel path taken out and every import pointed here.  It imports
nothing of the program: it builds its own problem and plant from the
configuration dict of ``benchmark/configs/<name>.json`` and recomputes, in
float64, what the program's timed path produced (``benchmark/check.py``).
Later changes to the program do not reach it.
"""
