"""Models of the port: YOLOX and weight conversion."""
