"""Optimiser-side helpers of the port (the int8 convention, ``quant``)."""
