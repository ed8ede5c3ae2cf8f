from repro_torch.quant.qtensor import (QuantizedTensor, dequant_arrays,
                                      pack_bits, quantize, quantized_nbytes,
                                      unpack_bits, unpack_codes_int8)

__all__ = ["QuantizedTensor", "dequant_arrays", "pack_bits", "quantize",
           "quantized_nbytes", "unpack_bits", "unpack_codes_int8"]
