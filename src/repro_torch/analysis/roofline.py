"""Peak rates of the card the port runs on.

The port's counterpart of ``repro.analysis.roofline``, reduced to the
two constants ``Engine.latency_prior`` reads. The reference holds a TPU's
peaks; these are one NVIDIA H100 SXM's, from NVIDIA's data sheet (dense
rates, at the card's full 700 W power limit): the GCN's kernels and its
X·W run in float32 outside the tensor cores (TF32 is off), so the
compute peak is the float32 FFMA rate.
"""
PEAK_FLOPS = 67e12      # float32 FLOP/s, CUDA cores (FFMA)
HBM_BW = 3.35e12        # device memory bytes/s (HBM3)
