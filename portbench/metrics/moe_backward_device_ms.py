"""``backward_device_ms`` in the mixture-of-experts refit: device time a
step of the kernels launched inside the program's ``train.backward``
span, read by that metric's own reader."""

from portbench import spec


def read(r):
    return spec.metric("backward_device_ms").read(r)
