"""The benchmark's one-off tools: the frozen work count and the control's readings."""
