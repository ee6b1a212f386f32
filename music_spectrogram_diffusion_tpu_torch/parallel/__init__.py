"""The ('data', 'model') mesh and multi-process training."""
