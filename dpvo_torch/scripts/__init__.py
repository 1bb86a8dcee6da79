"""Entry points of the port that are not part of a runtime: the correlation
probes (micro_fused_v2, micro_corr_floor, micro_onepass_dma,
micro_kernel_variants), each run as `python -m dpvo_torch.scripts.<name>`."""
