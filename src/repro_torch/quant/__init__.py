from repro_torch.quant.ptq import (dequant_or_identity, dequantize_tree,
                                   quantize_expert_bank, quantize_tree)
from repro_torch.quant.qtensor import (QuantizedTensor, dequant_arrays,
                                       pack_bits, quantize, quantized_nbytes,
                                       unpack_bits, unpack_codes_int8)
from repro_torch.quant.sensitivity import (expert_sensitivity,
                                           load_sensitivity,
                                           model_sensitivity, normalize,
                                           save_sensitivity)

__all__ = ["QuantizedTensor", "dequant_arrays", "dequant_or_identity",
           "dequantize_tree", "expert_sensitivity", "load_sensitivity",
           "model_sensitivity", "normalize", "pack_bits", "quantize",
           "quantize_expert_bank", "quantize_tree", "quantized_nbytes",
           "save_sensitivity", "unpack_bits", "unpack_codes_int8"]
