"""The CCGM eval protocol (counterpart of ccdm_tpu/eval/): SFID, Label
Score, Diversity, FID, IS, PRDC, intra-class FID, native NIQE, the
analysis passes, and the pinned eval backbones they run on."""
