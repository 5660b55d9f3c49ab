"""Host-side utilities of the port: collate, parallel map, image loading."""
