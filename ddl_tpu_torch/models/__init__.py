"""Model families of the port: the Llama decoder, the MoE decoder, the
Vision Transformer and the pointwise regressor."""
