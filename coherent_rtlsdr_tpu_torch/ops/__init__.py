"""Elementwise DSP ops of the fused path."""
