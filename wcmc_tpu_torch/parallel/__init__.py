"""The data-, spatial- and sample-parallel modes over ``torch.distributed``
(counterpart of ``wcmc_tpu/parallel``): ``launch`` starts the ranks,
``mesh`` lays them out and runs the data-parallel step, ``halo`` the
row-sharded inference, ``sample`` the spp-sharded forwards, and
``collectives`` holds the all-reduce helpers the models use.  Import the
modules themselves: the models import ``collectives``, so this file
imports nothing."""
