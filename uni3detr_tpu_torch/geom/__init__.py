"""Box codes and exact rotated IoU of the port."""
