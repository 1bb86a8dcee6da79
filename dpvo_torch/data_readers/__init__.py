"""Data readers (numpy): synthetic scenes with exact ground truth."""
