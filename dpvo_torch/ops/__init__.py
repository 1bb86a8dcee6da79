"""Patchify, segment scatter and correlation ops (plain PyTorch + the CUDA
correlation kernels behind corr_onepass and corr_fused)."""
