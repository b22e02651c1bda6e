"""Debug hooks (`debug`) and the TensorBoard error image (`image`)."""
