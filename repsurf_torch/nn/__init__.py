"""Layers and RepSurf blocks as ``nn.Module``s over channels-last tensors."""
