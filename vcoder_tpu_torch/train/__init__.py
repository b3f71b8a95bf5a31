"""Training: the stage-3 adapter step, its optimizer and the trainer loop."""
