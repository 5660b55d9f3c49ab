"""The fused detect -> track engine of the port."""
