"""How the harness builds a configuration's scene in the port: one module a
``port_scene`` kind, each with ``build(cfg, device) -> (scene, animate)``
(``animate``: the port's animator, with its row-10 table)."""
