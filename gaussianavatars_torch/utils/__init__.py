"""Debug hooks (`debug`), the TensorBoard error image (`image`), step timing
and tracing (`profiling`) and the speed-of-light model (`roofline`)."""
