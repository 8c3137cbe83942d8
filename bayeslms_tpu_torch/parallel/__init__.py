"""Multi-device training and scoring over ``torch.distributed``: ``mesh``
(the (dp, tp) layout of the ranks and its collectives), ``multihost``
(joining and launching ranks), ``train_parallel`` (the dp and tp steps)."""
