"""Training-loop seams of the port: checkpointed, interruption-safe
training with bit-identical resume (mirrors the decision-forest part of
``repro.train``)."""
