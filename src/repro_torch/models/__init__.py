"""Dense decoder family: layers, GQA attention, transformer."""
