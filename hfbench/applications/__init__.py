"""The applications a configuration names, one file each, found by the
``application`` key of ``configs/<config>.json``.

Each file ``<application>.py`` defines:

* ``Program(cell, device)``: the cell's program, built through the
  port's entry points in set-up.  It states ``dtype``, ``dim`` (the
  parameter's dofs: the width of the draws and of m), ``state_dim`` (the
  width of u), ``dq`` (the observations) and ``bands``, the (nb, s) of
  each Newton level's band, fine level first.  ``run_pass(draws, noise)``
  runs one input active subspace and returns (projector, d, V, encoder);
  ``coarse_iterations()`` gives the last pass's Newton iterations of each
  coarse level as device scalars (none without a coarse level); ``free()``
  drops the program's state.
* ``reference(cell, dtype, device, arith)``: the plain reference of the
  cell's problem, which imports nothing of the program.  It states ``n``
  (the parameter's dofs), ``dtype``, ``device`` and ``ar`` (its
  ``reference.blocktri.Arith``), and answers ``sample(noise)``,
  ``solve(m)`` (u, converged, iterations), ``observe(u)``,
  ``jacobians(u, m)``, ``R(X)``, ``Rinv(X)`` and ``batch_size()`` (the
  samples it solves at once).
* ``band_need_seconds(levels, dq, n_samples, dtype)``: the least seconds
  (``roofline.py``) of the band work one pass needs, from its levels'
  ((nb, s), Newton iterations summed over the samples), fine level first.
"""
