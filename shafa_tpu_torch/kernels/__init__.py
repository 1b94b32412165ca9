"""Device stages of the port: K1-K6 as CUDA kernels, the rest plain torch.

Every kernel wrapper takes its plain PyTorch version for a tensor on the CPU
(the tests, ``SHAFA_TORCH_DEVICE=cpu``) and launches its CUDA kernel for a
tensor on the card; it never falls back from one to the other.

  K1  emit.py        csrc/emit.cu        bit emission (RLE encode, pack)
  K2  decode.py      csrc/rank.cu        code rank per bit position
  K3  decode.py      csrc/fsm_decode.cu  boundary FSM + symbol emission
  K4  expand.py      csrc/expand.cu      RLE run expansion
  K5  decode.py      csrc/rank32.cu      code rank per bit position, 17-32 bits
  K6  decode.py      csrc/fsm32.cu       32-state boundary FSM + symbol packs
"""
