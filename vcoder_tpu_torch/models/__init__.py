"""Model definitions of the port: CLIP tower, Llama decoder, projectors and
the unified VCoder model, as functions over parameter dicts of tensors."""
