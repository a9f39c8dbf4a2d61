"""OVP quantization core: data types, codecs, scale search, policies,
the quantized linear op (`qlinear`) and calibration (`calibration`).
Exports the data-type, codec, policy and quantizer names the
reference's `repro/core/__init__.py` exports; `qlinear` and `calibration` reach the backends, which
import this package, so their names are imported from the modules."""
from .datatypes import (ABFLOAT_FOR_NORMAL, E2M1_FLINT4, E2M1_INT4,
                        E4M3_INT8, FLINT4_LUT, ID4, ID8, NORMAL_MAX,
                        AbfloatSpec, abfloat_decode, abfloat_encode,
                        abfloat_nearest, abfloat_spec_for, default_bias,
                        flint4_decode, flint4_encode, normal_decode,
                        normal_encode)
from .ovp import (QuantizedTensor, ovp_decode_codes, ovp_dequantize,
                  ovp_encode_codes, ovp_fake_quant, ovp_quantize, pack4,
                  pair_statistics, unpack4)
from .policy import (PRESETS, PROGRAM_PRESETS, PolicyProgram, QuantPolicy,
                     Rule, as_program, get_policy, get_program, parse_rules,
                     resolve)
from .quantizer import (QuantSpec, dequantize, fake_quant_ste,
                        ovp_search_scale, ovp_search_scale_per_channel,
                        quantization_error, quantize, sigma_init_scale)
