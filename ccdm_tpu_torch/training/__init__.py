"""Sampling helpers of the trainer; training itself comes in a later slice."""
