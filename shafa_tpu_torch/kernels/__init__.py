"""Device stages of the port: K1-K9 as CUDA kernels, the rest plain torch.

Every kernel wrapper takes its plain PyTorch version for a tensor on the CPU
(the tests, ``SHAFA_TORCH_DEVICE=cpu``) and launches its CUDA kernel for a
tensor on the card; it never falls back from one to the other.

  K1  emit.py        csrc/emit.cu        bit emission (RLE encode, pack)
  K2  decode.py      csrc/rank.cu        code rank per bit position
  K3  decode.py      csrc/fsm_decode.cu  boundary FSM + symbol emission
  K4  expand.py      csrc/expand.cu      RLE token scan + run expansion
  K5  decode.py      csrc/rank32.cu      code rank per bit position, 17-32 bits
  K6  decode.py      csrc/fsm32.cu       32-state boundary FSM + symbol packs
  K7  decode.py      csrc/fsm_decode.cu  8/16-state boundary FSM + symbol packs
  K8  rle.py         csrc/rle_encode.cu  RLE encode + its histogram
  K9  decode.py      csrc/decode_tables.cu  a decode batch's rank tables + LUT
"""
