"""Encoders, VONet and checkpoint loading."""
