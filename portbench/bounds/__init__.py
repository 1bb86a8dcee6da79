"""Roofline bounds of single kernels, one module per bound, named by a
span's `bound` key: capture(args, kwargs) keeps what the bound needs of a
call while it is traced (no device work, no read back); seconds(record)
gives the least time the card could take for that call."""
