"""Patchify, segment scatter and correlation ops (plain PyTorch + the
CUDA correlation kernel behind corr_onepass)."""
