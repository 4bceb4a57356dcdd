"""Fleet batch assembly and the packed window programs (one device)."""
