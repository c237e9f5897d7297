"""The paper's own evaluation configs (Table III + Section VI-A2):
GCN / GraphSAGE, 2 layers, hidden 256, neighbor fanouts (25, 10),
mini-batch 1024, on ogbn-products / ogbn-papers100M / MAG240M(homo).
Port of ``repro/configs/hyscale_gnn.py``, field for field."""
from repro_torch.graph.models import GNNConfig

# name -> (dataset, GNNConfig)
PAPER_CONFIGS = {
    "gcn-products": ("ogbn-products",
                     GNNConfig(model="gcn", layer_dims=(100, 256, 47),
                               fanouts=(25, 10), num_classes=47)),
    "sage-products": ("ogbn-products",
                      GNNConfig(model="sage", layer_dims=(100, 256, 47),
                                fanouts=(25, 10), num_classes=47)),
    "gcn-papers100m": ("ogbn-papers100M",
                       GNNConfig(model="gcn", layer_dims=(128, 256, 172),
                                 fanouts=(25, 10), num_classes=172)),
    "sage-papers100m": ("ogbn-papers100M",
                        GNNConfig(model="sage", layer_dims=(128, 256, 172),
                                  fanouts=(25, 10), num_classes=172)),
    "gcn-mag240m": ("mag240m-homo",
                    GNNConfig(model="gcn", layer_dims=(756, 256, 153),
                              fanouts=(25, 10), num_classes=153)),
    "sage-mag240m": ("mag240m-homo",
                     GNNConfig(model="sage", layer_dims=(756, 256, 153),
                               fanouts=(25, 10), num_classes=153)),
}

PAPER_BATCH = 1024
PAPER_FANOUTS = (25, 10)
