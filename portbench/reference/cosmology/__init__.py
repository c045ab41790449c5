"""A frozen copy of the port's host cosmology (``constants``, ``params``,
``background``, ``eisenstein_hu``, ``halofit``): Eisenstein & Hu (1998)
transfer function, halofit (Takahashi et al. 2012), the growth ODE and
distances, in float64 NumPy/SciPy.  Frozen here so that a later change to
the program cannot move the yardstick."""
