"""Plain PyTorch references of what the cells drive.

Each module follows the published semantics and imports nothing of the
port: ``attribution`` (Kepler's ratio split), ``temporal`` (the temporal
estimator's single-query fast path), ``mlp`` (the MLP estimator's
forward, its masked MSE, the gradient by autograd and AdamW written
out). Products round their operands with a rounding from ``precision``
and accumulate in f32 with TF32 off (``precision.exact_f32``), so one
function gives both the reference (the precision a configuration states)
and its control (the next precision below).
"""
