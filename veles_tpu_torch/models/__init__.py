"""Forward units of the LM chain: Embedding → TransformerBlock×N →
TokenProjection (the port of ``veles_tpu/models`` for serving)."""
