"""DeepNVM++ core: cross-layer NVM cache modeling for DL workloads."""
from repro_torch.core.bitcell import SOT, SRAM, STT, TABLE1, Bitcell
from repro_torch.core.cache_model import (CachePPA, evaluate_batch,
                                          evaluate_config)
from repro_torch.core.sweep import SweepResult, iso_area_search, sweep
from repro_torch.core.traffic import (LayerStack, MemoryProfile,
                                      TrafficTensor, WorkloadPack,
                                      compute_traffic, modern_profiles,
                                      pack_workloads)
from repro_torch.core.tuner import tune, tune_all

__all__ = ["SOT", "SRAM", "STT", "TABLE1", "Bitcell", "CachePPA",
           "LayerStack", "MemoryProfile", "SweepResult", "TrafficTensor",
           "WorkloadPack", "compute_traffic", "evaluate_batch",
           "evaluate_config", "iso_area_search", "modern_profiles",
           "pack_workloads", "sweep", "tune", "tune_all"]
