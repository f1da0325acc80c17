"""Units and training of the LM chain: Embedding → TransformerBlock×N
→ TokenProjection, multi-head attention, the evaluators, solvers,
schedules and the ``GradientDescent`` trainer (the port of
``veles_tpu/models``)."""
