from cardbench.run import main

raise SystemExit(main())
