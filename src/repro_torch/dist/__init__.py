"""Distributed GST of the port: the shards and their collectives
(comm.py: threads of one process, or one process each over
torch.distributed), the row-sharded table (table.py), the table-exchange
strategies ring | alltoall | bucketed with the compressed wire format
(exchange.py), the data-parallel train/eval/refresh/finetune steps
(train.py) and the host-to-device segment pipeline (pipeline.py)."""
