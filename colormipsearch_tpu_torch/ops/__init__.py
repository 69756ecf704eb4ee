"""Device operations of the pixel-match pass: host plan construction plus the
kernel wrappers (each with its plain PyTorch version)."""
