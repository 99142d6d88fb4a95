"""The general generators a traffic mix names (``generator``)."""
