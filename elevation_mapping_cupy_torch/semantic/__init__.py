"""Multi-modal (MEM) semantic layers: fusion algorithms and their dispatch."""
