"""One file a family, named by a configuration's ``family``: what a cell
of the family brings to the harness, and the program side its driver
calls. The harness takes from it:

- ``FIELDS``: the traffic mix's fields (beside its driver's ``FIELDS``),
  and ``traffic(mix)``, the mix as the family reads it (with
  ``warmup_rounds``, the rounds the harness warms up with);
- ``make_inputs(cfg, traffic, seed, device)``: the cell's inputs, made
  from the seed, which the driver's client receives;
- ``compare(cell, inputs, results, g_end, leaves, seed, device)``: the
  numbers compared, after the window, with the program's state freed;
- ``describe(inputs)``: the inputs' sizes, for the run's log;
- ``PREFIXES``: the prefixes of the program's spans that a traced run
  keeps by name (``portbench/program_trace.py``).

The tenant bank's families (``klms``, ``krls``) take these from
``portbench/bank.py``; their program side is the fresh bank state, the
hyperparameters of the chunk step, the keyword arguments of
``reset_slots`` and the state leaves the comparison reads."""
