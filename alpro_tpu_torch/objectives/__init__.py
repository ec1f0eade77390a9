"""Finetuning objectives: VTC (contrastive) and VTM (matching with hard negatives)."""
