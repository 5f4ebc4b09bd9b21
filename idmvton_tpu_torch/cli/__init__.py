"""Command-line entry points: VITON-HD and DressCode inference."""
