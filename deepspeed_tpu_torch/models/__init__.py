"""Models of the port: the GPT-2 family (``gpt``), its KV-cached
inference (``gpt_inference``), BERT (``bert``), the diffusion UNet and VAE
(``diffusion``) and weight conversion from the JAX package's parameter
tree (``convert``)."""
