"""The detector's ``nn.Module``s, named after the reference checkpoint."""
