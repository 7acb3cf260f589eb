"""Training of the port: losses, the train step, decode and post-processing."""
