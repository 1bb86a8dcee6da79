"""Training: the unrolled VONet, the differentiable BA, the loss and the optimizer step."""
