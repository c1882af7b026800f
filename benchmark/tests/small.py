"""Small sizes at which the CPU tests rehearse each cell: the cells'
configurations and traffic with fewer steps, narrower nets and a few
images (widths cut here only; the cells run the published ones)."""

SMALL = {
    "glow_mnist.train_b24576": dict(num_blocks=2, block_size=2,
                                    coupling_width=16, batch=6,
                                    reference_rows=4),
    "glow_mnist.sample_b32768": dict(num_blocks=2, block_size=2,
                                     coupling_width=16, batch=6,
                                     reference_rows=4),
}

# where the control must fail: wide enough nets (and for the sample, deep
# enough) that TF32 rounding shows
CONTROL = {
    "glow_mnist.train_b24576": dict(num_blocks=2, block_size=2,
                                    coupling_width=32, batch=8,
                                    reference_rows=8),
    "glow_mnist.sample_b32768": dict(num_blocks=2, block_size=16,
                                     coupling_width=64, batch=32,
                                     reference_rows=32),
}
