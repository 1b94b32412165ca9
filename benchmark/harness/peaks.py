"""Published peaks of the cards, by ``torch.cuda.get_device_name()``.

NVIDIA's H100 data sheet, SXM part, at its 700 W limit: 3.35 TB/s of HBM3.
A card missing here has no roofline: its readers return nothing.
"""

HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}
