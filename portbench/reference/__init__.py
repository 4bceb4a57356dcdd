"""Plain PyTorch references of what the cells drive.

Each module follows the published semantics and imports nothing of the
port: ``attribution`` (Kepler's ratio split), ``temporal`` (the temporal
estimator's single-query fast path), ``mlp`` (the MLP estimator's
forward, its masked MSE and the gradient by autograd), ``adamw`` (AdamW
written out, and the full-batch refit any family shares) and
``refit_<model>`` (a family's refit as the refit driver finds it: its
start, its inputs from the dumps, its loss and gradient). Products
round their operands with a rounding from ``precision`` and accumulate
in f32 with TF32 off (``precision.exact_f32``), so one function gives
both the reference (the precision a configuration states) and its
control (the next precision below).
"""
