"""Attribution math and the fleet window's hand-written CUDA kernels."""
