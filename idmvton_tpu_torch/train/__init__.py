"""Fine-tuning: the training step, its optimizers, int8 AdamW."""
