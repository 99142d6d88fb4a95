"""LM substrate of the port: transformer and MoE building blocks and the
attention families' model assembly (mirrors ``repro.models``; the SSM
blocks are ROADMAP A9.2)."""
