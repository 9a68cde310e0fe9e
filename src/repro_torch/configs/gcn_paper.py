"""The paper's own training configs (§5.1; port of
:mod:`repro.configs.gcn_paper`): 2-layer GCN / GraphSAGE, hidden 256,
GraphSAGE NS fanouts (25, 10), batch 1024, on Flickr / Reddit / Yelp /
AmazonProducts."""
from repro_torch.graph.datasets import DATASET_STATS
from repro_torch.models.gcn_model import GCNConfig

FANOUTS = (10, 25)        # layer order: hop1 fanout 25 is the deeper sample
BATCH = 1024
HIDDEN = 256


def gcn_config(dataset: str, model: str = "gcn",
               dataflow: str = "ours") -> GCNConfig:
    st = DATASET_STATS[dataset]
    return GCNConfig(name=f"{model}-{dataset}", feat_dim=st.feat_dim,
                     hidden=HIDDEN, n_classes=st.n_classes, n_layers=2,
                     model=model, dataflow=dataflow,
                     multilabel=st.multilabel)


CONFIGS = {
    f"{m}-{d}": gcn_config(d, m)
    for d in DATASET_STATS for m in ("gcn", "sage")
}
