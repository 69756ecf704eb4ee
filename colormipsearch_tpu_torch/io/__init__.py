"""Host-side data plane: image decode, MIP enumeration, result files."""
