"""Training objectives: VTC (contrastive), VTM (matching with hard negatives),
MLM (masked language modelling) and PEM/MPM (prompting entity modelling)."""
