"""Federation layer of the port: so far the quantization codec."""
