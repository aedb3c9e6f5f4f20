"""Models of the port (the ViT/DeiT supernet of the serving path)."""
