"""Federation layer of the port: the vertically federated backends
(parties as column blocks of one process), their transports and the
wire-byte ledger."""
