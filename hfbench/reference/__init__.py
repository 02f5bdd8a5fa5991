"""The plain reference of the confusion cells.

Plain PyTorch and NumPy only: it imports neither JAX nor any module of the
measured program.  From the cell's inputs alone (mesh size, velocity dof
values, the prior's white noise and the probe block) it works out again
every quantity the program derives: the mesh and its P1 quadrature, the
prior's mass and stiffness, the prior samples, the Newton solves of the
confusion form, the observations, the Jacobians and the randomized GHEP.
"""
