"""R002 suppressed inline, with its reason."""
import torch


def graph_body(g, x):
    with torch.cuda.graph(g):  # repro: allow[R001] R002's corpus
        # a capture that exists to be refused, in a test of the refusal
        x.item()  # repro: allow[R002]
