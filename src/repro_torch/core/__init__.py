"""ProFe core in PyTorch: KD + prototypes + quantized gossip."""
