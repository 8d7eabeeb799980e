"""Model families of the port (dense and moe)."""
