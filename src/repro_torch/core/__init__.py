"""OVP quantization core: data types, codecs, scale search, policies and
the quantized linear op."""
