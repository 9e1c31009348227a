"""Losses and scores of the port (`ldt_torch.eval.loss`)."""
