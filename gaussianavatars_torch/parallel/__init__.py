"""Multi-device training over a ('data', 'tile') rank mesh with torch.distributed:
`mesh`, `distributed` (runtime, collectives, the local launcher), `sharded` (the step)."""
