"""Multi-device scale-out on `torch.distributed`: device meshes, the sharded
candidate searches, the sequence-parallel velocity profile and weak scaling."""
